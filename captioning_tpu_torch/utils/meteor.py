"""METEOR 1.5 via the external Java jar (stdio protocol).

The reference scores METEOR through coco-caption's ``pycocoevalcap.meteor``
wrapper around ``meteor-1.5.jar`` (``captioning/utils/
eval_utils.py:20-24``), which drives the jar in ``-stdio`` mode: one
``SCORE ||| ref1 ||| ref2 ... ||| test`` line per segment yields a stats
vector, then ``EVAL ||| stats`` yields the segment score, and a final line
carries the aggregate score.  This module reimplements that plumbing.

Gated: without a jar the caller falls back to the native approximation
(reported as ``METEOR_approx``).  A "jar" path ending in ``.py`` runs under
the current Python interpreter — the mocked-jar unit-test hook.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Tuple

_JAR_CANDIDATES = [
    'coco-caption/pycocoevalcap/meteor/meteor-1.5.jar',
    os.path.join(os.path.dirname(__file__),
                 '../../coco-caption/pycocoevalcap/meteor/meteor-1.5.jar'),
]


def find_meteor_jar() -> Optional[str]:
    env = os.environ.get('METEOR_JAR')
    if env and os.path.isfile(env):
        return env
    for cand in _JAR_CANDIDATES:
        if os.path.isfile(cand):
            return os.path.abspath(cand)
    return None


def _jar_command(jar: str) -> List[str]:
    args = ['-', '-', '-stdio', '-l', 'en', '-norm']
    if jar.endswith('.py'):  # test hook: emulated jar
        return [sys.executable, jar] + args
    java = os.environ.get('METEOR_JAVA', 'java')
    if shutil.which(java) is None:
        raise FileNotFoundError('java executable not found for METEOR')
    return [java, '-jar', '-Xmx2G', jar] + args


class MeteorScorer:
    """compute_score(gts, res) -> (corpus score, per-image scores)."""

    def __init__(self, jar: Optional[str] = None):
        self.jar = jar or find_meteor_jar()
        if self.jar is None:
            raise FileNotFoundError('METEOR jar not found')
        self._lock = threading.Lock()
        self._proc = subprocess.Popen(
            _jar_command(self.jar), cwd=os.path.dirname(self.jar) or '.',
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            universal_newlines=True, bufsize=1)

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        img_ids = list(res.keys())
        with self._lock:
            eval_line = 'EVAL'
            for i in img_ids:
                assert len(res[i]) == 1
                hypo = res[i][0].replace('|||', '').replace('  ', ' ')
                refs = [r.replace('|||', '').replace('  ', ' ')
                        for r in gts[i]]
                score_line = ' ||| '.join(
                    ('SCORE', ' ||| '.join(refs), hypo))
                self._proc.stdin.write(score_line + '\n')
                stats = self._proc.stdout.readline().strip()
                eval_line += ' ||| {}'.format(stats)
            self._proc.stdin.write(eval_line + '\n')
            scores = [float(self._proc.stdout.readline().strip())
                      for _ in img_ids]
            final = float(self._proc.stdout.readline().strip())
        return final, scores

    def close(self):
        with self._lock:
            if self._proc.poll() is None:
                self._proc.stdin.close()
                self._proc.wait(timeout=5)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
