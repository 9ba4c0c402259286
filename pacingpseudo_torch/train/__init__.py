"""Train state, optimizer, schedules and the train/eval steps."""
