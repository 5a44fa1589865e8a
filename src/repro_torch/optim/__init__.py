"""AdamW, the learning-rate schedules and int8 gradient compression: the
port's copies of ``repro/optim/``."""
