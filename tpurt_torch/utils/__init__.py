"""Numpy helpers of the port: the image metrics."""
