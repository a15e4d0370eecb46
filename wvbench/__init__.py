"""wvbench: the benchmark of wvpk_torch on one NVIDIA H100.

`python3 wvbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line. Cells, configurations, traffic mixes and metrics are files found by
name (`configs/`, `traffic/`, `metrics/`); `gen/` (signal synthesis and a
frozen WavPack encoder) and `ref/` (a frozen scalar decoder) are the
yardstick and import nothing of the program.
"""
