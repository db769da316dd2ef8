"""The benchmark of scail_tpu_torch (the PyTorch and CUDA port of SCAIL).

`python3 -m portbench.run` measures one cell of BENCHMARK.json on the card;
see portbench/README.md.  Nothing here imports JAX or the JAX package."""
