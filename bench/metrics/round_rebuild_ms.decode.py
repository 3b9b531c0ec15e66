"""round_rebuild_ms.decode: host ms per fused decode round spent rebuilding
what the previous round had (the program's ``snapmla.round.buffers``,
``.eager``, ``.capture`` and ``.release`` ranges in the traced window, over
the rounds that start in it)."""
import _spans


def read(run):
    return _spans.rebuild_ms_per_round(run)
