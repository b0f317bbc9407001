"""CI gate for the north-star composed pipeline (scripts/northstar_train.py).

Runs the full end-to-end loop — synthetic power-law graph, threaded
random-walk sampling + negative sampling, owner-sharded halo partition,
bf16-amp halo train steps on the 8-way
virtual mesh, full-state checkpoint written AND restored mid-run — at a
small envelope, and gates on the same acceptance criteria the full-size
artifact (NORTHSTAR.json) is held to: monotone-ish decreasing loss over
>= 6 steps and a verified checkpoint round-trip.

Reference loop being matched: UnsupervisedNodeClassification/Model/DMPNN/
src/main.py:119-209 (the Yelp training loop).
"""

import numpy as np


def test_northstar_small_envelope():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from northstar_train import run

    result = run(v=2000, e=40_000, steps=6, shards=8, batch=400,
                 depth=2, width=6, amp=True, log=lambda s: None)

    assert result["steps"] == 6
    assert len(result["losses"]) == 6
    assert all(np.isfinite(x) for x in result["losses"])
    # monotone-ish: the mean of the last half is below the first loss
    assert result["loss_last_half_mean"] < result["loss_first"]
    assert result["loss_decreased"]
    assert result["checkpoint_verified"]
    assert result["amp"]
    assert 0.0 <= result["sample_overlap_fraction"] <= 1.0
