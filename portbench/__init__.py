"""The benchmark of the PyTorch and CUDA port (`f_lite_tpu_torch`) on
NVIDIA H100s: one command runs one cell once (`python3 -m portbench.run`,
see `run.py` and `README.md`). It imports nothing of JAX or of the JAX
package."""
