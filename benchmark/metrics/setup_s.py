"""setup_s: from the program's import to the end of its first query (host
clock): torch and the program imported, the program's build or its load
from the build directory, the CUDA context, one warm query of the cell's
own shape. The inputs, made from the seed before the clock starts, are not
in it."""


def read(run):
    return run.setup_s
