"""Optimizers of the training plane."""
