"""Measurement tools of the port that run on the card (the streaming-rate
probe P)."""
