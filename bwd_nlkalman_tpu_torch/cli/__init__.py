"""Command-line tools of the port, mirroring the reference binaries and
scripts as the JAX package's do; each takes the flags of its JAX twin
plus ``--device`` (default ``cuda``) where it computes on a device.

| module             | mirrors                              | device |
|--------------------|--------------------------------------|--------|
| nlkalman_flt       | nlkalman-flt (src/main-flt.c)        | yes    |
| nlkalman_smo       | nlkalman-smo (src/main-smo.c)        | yes    |
| tvl1flow           | tvl1flow (lib/tvl1flow/main.c)       | yes    |
| nlkalman_seq       | scripts/nlkalman-seq.sh + -gt.sh     | yes    |
| msnlkalman_seq     | scripts/msnlkalman-seq.sh + -gt.sh   | yes    |
| msnlkalman_lz3_seq | scripts/msnlkalman-lz3-seq.sh + -gt  | yes    |
| iion               | iion (lib/imscript-lite/src/iion.c)  | no     |
| awgn               | awgn (lib/imscript-lite)             | no     |
| psnr               | scripts/psnr.sh                      | no     |
| decompose          | decompose (lib/multiscale)           | yes    |
| recompose          | recompose (lib/multiscale)           | yes    |
| plambda            | plambda (lib/imscript-lite)          | no     |

Run as ``python -m bwd_nlkalman_tpu_torch.cli.<tool> ...``.
"""

COMMANDS = ("nlkalman_flt", "nlkalman_smo", "tvl1flow", "nlkalman_seq",
            "msnlkalman_seq", "msnlkalman_lz3_seq", "iion", "awgn", "psnr",
            "decompose", "recompose", "plambda")
