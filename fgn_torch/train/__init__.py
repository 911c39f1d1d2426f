"""Training: the optimizer and schedules, the train and eval steps."""
