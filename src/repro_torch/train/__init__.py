"""LM training of the port: the train step (``step.py``) and its loss
(``loss.py``)."""
