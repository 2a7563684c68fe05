"""Share [%] of the traced window's forwards whose layering and path ran
as CUDA graph replays: the forwards whose record holds the program's span
``nemesis.layering.replay``. None where the program has no graph runner
(``archnemesis_tpu_torch.rt.layer_graph``, so no such span) or keeps no
records."""

import importlib.util

from nembench.harness import spans

REPLAY_SPAN = "nemesis.layering.replay"
RUNNER = "archnemesis_tpu_torch.rt.layer_graph"


def read(ctx):
    if importlib.util.find_spec(RUNNER) is None:
        return None
    recs = spans.records(ctx)
    if not recs:
        return None
    return 100.0 * sum(REPLAY_SPAN in r.spans for r in recs) / len(recs)
