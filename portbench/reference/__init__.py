"""The plain reference the benchmark holds the program against.

Plain PyTorch and NumPy, written from the published equations of the
DL-CCVM and MF-CCVM (arXiv:2209.04415) and the reference library's BoxQP
conventions.  It imports nothing of ``ccvm_tpu_torch`` and takes nothing
the program made: it reads the ``.in`` files itself, scales them itself and
draws the Philox noise itself.
"""
