"""The train step (losses, metrics, Adam with StepLR, checkpoints, meters)
and the greedy-eval step."""
