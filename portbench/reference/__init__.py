"""The plain reference of the benchmark: PyTorch in f32 with TF32 off.

It imports no module of the port and no JAX; what it needs of the benchmark
(the weights' recipe, the frozen STA geometry) lives in portbench."""
