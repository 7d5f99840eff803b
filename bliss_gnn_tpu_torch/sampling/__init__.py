"""Capacity planning, on-device subgraph algebra and the LADIES-family
samplers with the EXP3 bandit update."""
