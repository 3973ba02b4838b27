"""The pipeline model and the JAX-variables -> state_dict conversion."""
