"""MAPQ model, calibrated against simulation truth.

MAPQ is defined as -10*log10(P(wrong placement)) capped at 60 (SAM spec;
minimap2 role at reference Snakefile:61).  The aligner's raw confidence
signal is the chain-score margin 1 - s2/s1 between the best and
second-best candidate loci; scripts/calibrate_mapq.py measures the
empirical wrong-placement probability as a function of that margin on
clean and ONT-like simulations (MAPQ_CALIBRATION.json) and this module
pins the resulting piecewise-linear fit.

Calibration result (MAPQ_CALIBRATION.json, 20k clean + 20k ONT-profile
reads incl. repeat content): single-candidate reads had 0 observed
errors in 36k placements (phred lower bound 45.6 -> keep the SAM
convention 60); margins below 0.05 are toss-ups (empirical error
0.2-1.0 -> Q0-3); the wide-margin bins are error-free with phred lower
bounds 11.5 / 18.3 / 21.1 / 26.4 / 34.9 at 0.1 / 0.15 / 0.25 / 0.4 /
0.6+.  The knots below track those LOWER bounds — deliberately
conservative (never more than Q40 with a competing candidate: wide-
margin errors come from repeat copies the seeder never found, which
the margin cannot see).
"""

from __future__ import annotations

import numpy as np

# piecewise-linear (margin -> mapq) knots from MAPQ_CALIBRATION.json
_KNOT_X = np.array([0.0, 0.02, 0.05, 0.15, 0.40, 0.60, 1.0])
_KNOT_Q = np.array([0.0, 1.0, 3.0, 12.0, 22.0, 27.0, 40.0])
MAPQ_UNIQUE = 60        # no second candidate anywhere in the genome


def mapq_from_scores(s1: float, s2: float) -> int:
    """MAPQ of a primary alignment with best/second-best scores s1 >= s2."""
    margin = 1.0 - s2 / max(s1, 1e-9)
    return int(np.interp(margin, _KNOT_X, _KNOT_Q))


def mapq_from_scores_vec(s1: np.ndarray, s2: np.ndarray, nh: np.ndarray,
                         ranks: np.ndarray) -> np.ndarray:
    """Vectorized MAPQ: rank>0 (secondary) records get 0, single-candidate
    reads MAPQ_UNIQUE, the rest the calibrated margin curve."""
    margin = 1.0 - s2 / np.maximum(s1, 1e-9)
    q = np.interp(margin, _KNOT_X, _KNOT_Q).astype(np.int32)
    q = np.where(nh == 1, MAPQ_UNIQUE, q)
    return np.where(ranks == 0, q, 0).astype(np.int32)
