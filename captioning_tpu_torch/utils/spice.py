"""SPICE metric via the external Java scene-graph pipeline.

The reference computes SPICE through coco-caption's ``pycocoevalcap.spice``
wrapper around ``spice-1.0.jar`` (``captioning/utils/
eval_utils.py:20-24,96-99``).  This module provides the same subprocess
plumbing natively: serialize (gts, res) to the jar's input json, invoke the
jar, parse per-image category F-scores back out.

Gated: when no jar is discoverable the caller should skip SPICE cleanly.
For unit-testing the plumbing without Java, a "jar" path ending in ``.py``
is executed with the current Python interpreter instead of ``java -jar``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

# Default locations mirroring the reference's submodule layout.
_JAR_CANDIDATES = [
    'coco-caption/pycocoevalcap/spice/spice-1.0.jar',
    os.path.join(os.path.dirname(__file__),
                 '../../coco-caption/pycocoevalcap/spice/spice-1.0.jar'),
]


def find_spice_jar() -> Optional[str]:
    """Locate the SPICE jar (env ``SPICE_JAR`` wins), or None."""
    env = os.environ.get('SPICE_JAR')
    if env and os.path.isfile(env):
        return env
    for cand in _JAR_CANDIDATES:
        if os.path.isfile(cand):
            return os.path.abspath(cand)
    return None


def _jar_command(jar: str, args: List[str]) -> List[str]:
    if jar.endswith('.py'):  # test hook: emulated jar
        return [sys.executable, jar] + args
    java = os.environ.get('SPICE_JAVA', 'java')
    if shutil.which(java) is None:
        raise FileNotFoundError('java executable not found for SPICE')
    return [java, '-jar', '-Xmx8G', jar] + args


class SpiceScorer:
    """compute_score(gts, res) -> (mean All-F, per-image category dicts).

    Output shape matches coco-caption's Spice scorer: ``scores[i]`` is
    ``{'All': {'f': .., 'pr': .., 're': ..}, 'Relation': {...}, ...}`` so
    language_eval's per-category breakdown (reference eval_utils.py:96-99)
    reads it unchanged.
    """

    def __init__(self, jar: Optional[str] = None):
        self.jar = jar or find_spice_jar()
        if self.jar is None:
            raise FileNotFoundError('SPICE jar not found')

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[Dict]]:
        img_ids = list(res.keys())
        input_data = []
        for i in img_ids:
            hypo = res[i]
            refs = gts[i]
            assert len(hypo) >= 1 and len(refs) >= 1
            # AllSPICE feeds the n sampled captions as one multi-sentence
            # test string; the scene-graph parser unions the tuples across
            # sentences (reference eval_multi.py:36-69 via COCOEvalCapSpice).
            input_data.append({'image_id': str(i),
                               'test': ' . '.join(hypo),
                               'refs': list(refs)})

        tmp_dir = tempfile.mkdtemp(prefix='spice_')
        try:
            in_path = os.path.join(tmp_dir, 'input.json')
            out_path = os.path.join(tmp_dir, 'output.json')
            cache_dir = os.path.join(tmp_dir, 'cache')
            os.makedirs(cache_dir, exist_ok=True)
            with open(in_path, 'w') as f:
                json.dump(input_data, f)
            cmd = _jar_command(self.jar, [in_path, '-cache', cache_dir,
                                          '-out', out_path,
                                          '-subset', '-silent'])
            subprocess.check_call(cmd, cwd=tmp_dir,
                                  stdout=subprocess.DEVNULL)
            with open(out_path) as f:
                results = json.load(f)
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)

        by_id = {item['image_id']: item['scores'] for item in results}
        scores = []
        for i in img_ids:
            cat = {k: {sub: _to_float(v2) for sub, v2 in v.items()}
                   for k, v in by_id[str(i)].items()}
            scores.append(cat)
        import numpy as np
        mean = float(np.mean([s['All']['f'] for s in scores]))
        return mean, scores


def _to_float(x):
    try:
        f = float(x)
    except (TypeError, ValueError):
        return float('nan')
    return f
