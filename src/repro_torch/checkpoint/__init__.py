# The checkpoint layer: atomic, step-addressed saves gathered to the host.
