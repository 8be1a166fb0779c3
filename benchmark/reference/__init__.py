"""Plain PyTorch and numpy references of the layers a run is judged on:
the trajectory, the fused volume, and the model render of either
renderer.  They import nothing of the program."""
