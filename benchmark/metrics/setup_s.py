"""``setup_s``: from the process's start to the window's first call:
imports, the CUDA context, the kernels' library (built there on a
checkout's first run), the inputs, the warm-up and the graph captures."""


def read(view: dict):
    return view["setup_s"]
