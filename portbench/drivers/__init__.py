"""One driver per traffic kind: ``run(ctx) -> harness.Result``."""
