"""Training of the port: schedules, optimizers and state, the train/eval
steps and the single-process loop (``schedule``, ``state``, ``step``,
``loop``)."""
