"""sortbench — the benchmark of gpusorting_tpu_torch, the PyTorch/CUDA port.

Run one cell from the root of a checkout, on a machine with a CUDA card:

    python3 sortbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

BENCHMARK.json at the root names the cells, metrics and bounds; spec.py
says which files a configuration, a traffic mix and a metric are.  The
yardstick lives here and nowhere in the program: the input generators
(inputs.py), the plain reference and the control (reference.py), the work
counts (work/), the published peak (card.py) and the trace reduction
(trace.py).  From the program it takes only its public entry points.
`control.py` reads the control's numbers on the card; the CPU tests are
in tests/ (`python -m pytest sortbench/tests`).
"""
