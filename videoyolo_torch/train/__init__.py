"""Training: the lr schedules, the train and eval steps, checkpoints."""
