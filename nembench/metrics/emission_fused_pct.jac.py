"""Share [%] of the traced window's forward-plus-Jacobian evaluations
whose thermal emission took its tangents in one call: the evaluations
whose record holds the program's span ``nemesis.spectrum.tangent``. None
where the program has no such rule (``archnemesis_tpu_torch.rt.emission``
without ``TANGENT_SPAN``, so no such span) or keeps no records."""

import importlib
import importlib.util

from nembench.harness import jac_spans

TANGENT_SPAN = "nemesis.spectrum.tangent"
RULE = "archnemesis_tpu_torch.rt.emission"


def read(ctx):
    if (importlib.util.find_spec(RULE) is None or getattr(
            importlib.import_module(RULE), "TANGENT_SPAN", None) is None):
        return None
    recs = jac_spans.records(ctx)
    if not recs:
        return None
    return 100.0 * sum(TANGENT_SPAN in r.spans for r in recs) / len(recs)
