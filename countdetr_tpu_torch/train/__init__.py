"""Training of both stages: optimizer, schedule, train steps and the
pseudo-label engine."""
