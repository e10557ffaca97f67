"""Device operators: hash table, segment folds, radix top-k, and the
build and binding of the hand-written CUDA kernels (``kernels.py``)."""
