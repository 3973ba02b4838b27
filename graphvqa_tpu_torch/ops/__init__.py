"""Graph ops of the port: dense index ops and the fused GAT round."""
