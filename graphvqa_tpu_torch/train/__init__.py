"""Eval metrics and the greedy-eval step."""
