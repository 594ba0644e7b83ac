"""The plain reference that decides a run's ``correct``.

Plain PyTorch and numpy, frozen from the plain versions of the program
under test (``bwd_nlkalman_tpu_torch``): the NL-Kalman pass
(``core/engine.py::dense_pass_v2``), the TV-L1 pyramid and its level at
K2's semantics (``flow/tvl1.py``, ``flow/tvl1_fused.py::tvl1_level_plain``),
the bicubic warp (``ops/warp.py::bicubic_warp_plain``), the occlusion
mask, the DCT, window, blur and zoom constants, the TRAIN14 parameter
formulas and the reference-exact AWGN. It imports nothing of the program
(nor JAX, nor the JAX package) and takes nothing the program made: it
builds its own constants, flows, masks and noise from the inputs the
benchmark hands to both sides. Float32 throughout, TF32 off.
"""
