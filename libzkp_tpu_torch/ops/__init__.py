"""Field, curve, hash and transcript operations: host golden copies and their
torch device counterparts, plus the CUDA kernels of the MSM."""
