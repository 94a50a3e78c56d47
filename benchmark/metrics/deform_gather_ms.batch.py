"""Device ms a batch of the deformable convs' gathers (``ops/deform_conv.py``):
the kernels of its ``index_select`` of the four corners, named
``indexSelect...`` by older PyTorch and ``vectorized_gather_kernel`` by the
card's (2.11), and kernels named ``deform...``, as a hand kernel of the
program would be; None where the stretch has none.  Nothing else on the
deformable head's eval path launches a kernel of these names."""

import re

GATHER = re.compile(r"indexSelect|vectorized_gather|deform", re.IGNORECASE)


def read(trace):
    ds = [e - s for n, s, e in trace.ops if GATHER.search(n)]
    return sum(ds) / 1e3 / trace.units if ds else None
