"""verify_iters_per_seq (program counter): LoopDetector.verify_iters, the
batched verification ICP iterations a sequence (one batched NN each)."""

import statistics


def read(ctx):
    vals = [r["verify_iters"] for r in ctx.records if "verify_iters" in r]
    return statistics.mean(vals) if vals else None
