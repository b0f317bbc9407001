#!/bin/bash
# Validate every pinned quality/convergence artifact against its gate in
# one command. Each check RERUNS the full workload (chip for
# SCM/UNC training, CPU for evals) and fails if the pinned claim — incl.
# dev_beats_zero for the matching artifacts and quality_ok for the UNC
# ones — regresses. Individual checks are independent; comment out what
# you don't need. Several hours in all (the UNC evals are CPU sklearn).
set -ex
cd "$(dirname "$0")/.."

# SCM counting+matching convergence (Complex: counting generalizes,
# matching floor documented; ER/MUTAG: dev_beats_zero must reproduce)
python scripts/scm_convergence.py --pairs 4096 --max-epochs 40 \
    --check SCM_CONVERGENCE.json
python scripts/scm_convergence.py --family er --pairs 4096 \
    --max-epochs 100 --check SCM_CONVERGENCE_ER.json
python scripts/scm_convergence.py --family mutag --pairs 4096 \
    --max-epochs 100 --check SCM_CONVERGENCE_MUTAG.json

# UNC embedding quality (single-label ci scale + multi-label Yelp
# protocol; the pubmed-scale artifact adds hours of CPU sklearn — run
# its staged form separately if needed)
python scripts/unc_convergence.py --scale ci --cpu \
    --check UNC_CONVERGENCE.json
python scripts/unc_convergence.py --scale multi \
    --check UNC_CONVERGENCE_MULTI.json

# pinned throughput regressions (cheap, artifact-only)
python -m pytest tests/test_scm_matching_quality.py \
    tests/test_unc_quality.py::test_multi_artifact_pins_quality_and_supervised_arm \
    tests/test_regression.py -q
