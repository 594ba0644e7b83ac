"""Measurement tools of the port that run on the card: the streaming-rate
probe P (``vpu_probe``) and K1's timing in turns against another
checkout (``k1_bench``)."""
