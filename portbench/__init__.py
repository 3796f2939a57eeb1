"""The benchmark of the PyTorch and CUDA port (`repro_torch`): one command
runs one cell of BENCHMARK.json (``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``) and prints one JSON line.
Nothing it runs imports JAX or the JAX package `repro`."""
