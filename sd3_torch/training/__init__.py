"""Rectified-flow training of the port: flow objective, optimizers, trainer."""
