"""The forecaster model (``forecaster.py``) and its building blocks."""
