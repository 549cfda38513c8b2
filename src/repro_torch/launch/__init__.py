"""Entry points of the port's model zoo: the serving loop and the
prefill program."""
