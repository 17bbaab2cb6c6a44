"""Training of the port: schedules, optimizers and state, the train/eval
steps, the single-process loop, checkpoints and the resilience layer
(``schedule``, ``state``, ``step``, ``loop``, ``checkpoint``,
``resilience``)."""
