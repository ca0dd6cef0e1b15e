"""Batch-first alignment: the production surface. The unit of work
is a batch of pairs, bucketed and padded onto fixed-shape device kernels
(no reference counterpart — this replaces the OpenMP batch loop of
align_benchmark.c:232-306)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from quicked_tpu import generate
from quicked_tpu.api import BatchAligner

pairs = list(generate.generate_pairs(32, 200, error=0.1, seed=11))

aligner = BatchAligner()
result = aligner.align(pairs)

for i in range(3):
    print(f"pair {i}: score={result.score[i]} cigar={result.cigar[i][:40]}...")
print(f"... {len(pairs)} pairs aligned")
