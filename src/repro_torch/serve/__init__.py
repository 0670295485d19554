"""Greedy LM serving over ``models.model.Model`` (``engine``)."""
