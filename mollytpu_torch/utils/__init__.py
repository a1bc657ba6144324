"""Loggers, trajectory files, checkpoints, analysis and pictures."""
