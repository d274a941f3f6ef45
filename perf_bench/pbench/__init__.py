"""The benchmark harness of the PyTorch and CUDA port: what ``run.py``
drives (``spec`` finds the cell's files by name, ``campaign`` runs the
port's set-up and window, ``trace`` reads the profiler, ``roofline``
counts the kernels' work, ``check`` holds the window to the reference in
``refsim``)."""
