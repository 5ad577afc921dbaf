"""Vocos vocoder."""
