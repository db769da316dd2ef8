"""Training: the trainer, its optimizer, schedules and checkpoints."""
