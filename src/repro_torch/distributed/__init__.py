"""Tensor-parallel serving over ``torch.distributed`` (port of the serving
part of ``repro.distributed``): the quantized wire (``tp_serve``) and the
serve sharding rules (``sharding_rules``)."""
