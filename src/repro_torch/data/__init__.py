"""Synthetic data of the port (``pipeline.py``)."""
