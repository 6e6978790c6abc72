"""Distribution over ``torch.distributed`` (port of ``repro.distributed``):
the collectives (``comm``), tensor-parallel serving's quantized wire
(``tp_serve``), the logical axes and the FSDP x TP and serve sharding
rules (``sharding``, ``sharding_rules``), the quantized TP MLP block
(``tp_matmul``), compressed data-parallel gradients (``compression``)
and the GPipe pipeline (``pipeline``)."""
