# An obs host module (a stdlib-only surface: it loads by file path on hosts
# without torch or numpy) that imports numpy at module level.
# PINNED: ML010 must fire here (and nothing else may).
import json

import numpy as np


def dump(values):
    return json.dumps(np.asarray(values).tolist())
