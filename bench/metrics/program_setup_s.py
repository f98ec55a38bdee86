"""Process set-up: host seconds from the end of ``import torch`` to the
first timed call (the CUDA context, the seeded fill, the port's import
and plan build, the warm-up calls): the part of ``setup_s`` that the
program and the harness can move, without the interpreter's start and
``import torch``, which neither can."""


def read(rec):
    marks = dict(rec["marks"])
    if "import_torch" not in marks or "warm_up" not in marks:
        return None
    return marks["warm_up"] - marks["import_torch"]
