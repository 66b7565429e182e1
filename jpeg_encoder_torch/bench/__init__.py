"""The port's measurement tools: the counterparts of bench.py and tools/.

Each module runs on "cuda" unless --device cpu is given (then the plain
versions run and every time is the host clock's), prints its details to
stderr and ends its standard output with one JSON line:

    python -m jpeg_encoder_torch.bench           # bench.py
    python -m jpeg_encoder_torch.bench.matrix    # tools/bench_matrix.py, bench_cell.py
    python -m jpeg_encoder_torch.bench.tiled     # tools/bench_tiled.py
    python -m jpeg_encoder_torch.bench.dataset   # tools/bench_dataset.py
    python -m jpeg_encoder_torch.bench.scaling   # tools/bench_scaling.py
    python -m jpeg_encoder_torch.bench.kernels   # tools/time_kernel_only.py, profile_stages.py
    python -m jpeg_encoder_torch.bench.parity    # tools/hw_parity_sweep.py

bench/timing.py holds the timers they share.
"""
