"""Measurement tools of the port that run on the card: the streaming-rate
probe P (``vpu_probe``), and the timing of K1 (``k1_bench``), K2 and K3
(``tvl1_bench``) and K4 (``warp_bench``) in turns against another
checkout."""
