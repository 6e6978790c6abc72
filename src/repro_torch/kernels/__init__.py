"""Hand-written Hopper kernels (``csrc/``), their plain versions (``ref``)
and the backend dispatch around them (``ops``)."""
