"""Plain references of single stages, written from each stage's stated
semantics in NumPy (float64) or plain PyTorch, apart from ``refsim``: the
wheel dynamics' substeps, the 200 Hz IMU block, mutual-nearest-neighbour
Hamming matching (what kernel K1 computes) and the min-plus wavefront
relaxation (what kernel K2 computes).  They take a stage's inputs as the
program handed them and return what the stage should have returned.
Nothing here imports the port or ``refsim``."""
