"""kcbench: the benchmark of `repro_torch`, the PyTorch and CUDA port of DAKC.

`python kcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once on the card and prints one JSON line.

Everything that measures lives here and imports nothing of the port:
generation (`gen`), the plain reference and the comparison that decides
`correct` (`reference`), the control that the comparison must fail
(`control`), the trace's reduction (`tracing`) and the kernels' byte counts
(`kernel_bytes`). The system under test is driven by a closed loop,
`loops/<loop>.py`, around the common window (`window`). A cell is data:
`configs/<config>.json`, `traffic/<mix>.json` (which names its loop) and
one reader a metric in `metrics/<metric>.py`, each found by its name.
"""
