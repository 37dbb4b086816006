"""Sampling and the inference CLI of the port."""
