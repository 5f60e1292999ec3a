"""One reader a metric: `read(ctx)` -> a number, or None where the run holds
nothing for it to read (see harness.Context)."""
