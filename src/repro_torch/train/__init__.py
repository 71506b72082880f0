"""The LM train step (the port's `repro.train`)."""
