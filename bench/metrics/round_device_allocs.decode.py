"""round_device_allocs.decode: the CUDA runtime's device allocate and free
calls (``cudaMalloc``, ``cudaFree``) inside the program's ``snapmla.round``
ranges, per round; the harness's own allocations between rounds are not
counted."""
import _spans


def read(run):
    return _spans.allocs_per_round(run)
