"""Training path of the port: loss, optimizer, step, trainer."""
