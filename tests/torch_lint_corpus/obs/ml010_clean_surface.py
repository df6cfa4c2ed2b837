# Clean twin of obs/ml010_numpy_surface: the standard library alone, and
# numpy imported lazily where a caller has it.
# PINNED: no rule may fire here.
import json


def dump(values):
    return json.dumps(list(values))


def dump_array(values):
    import numpy as np

    return json.dumps(np.asarray(values).tolist())
