"""Optimizers (``optimizers.py``) and learning-rate schedules
(``schedule.py``) of the port's LM training."""
