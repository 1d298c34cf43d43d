"""Drivers of the traffic kinds: ``rollout`` (whole rollouts back to back
through ``InferencePipeline.generate``) and ``session`` (players over
``serve.SessionServer``'s HTTP API). Each has ``setup``, ``measure`` and
``teardown``; a mix file names its driver."""
