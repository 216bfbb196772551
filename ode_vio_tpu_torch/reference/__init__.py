"""A pure-torch replica of the reference stack and its evaluation protocol,
for ``cli.parity --torch_protocol``."""
