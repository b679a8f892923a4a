"""Stage-2 training: optimizer, schedule and the train step."""
