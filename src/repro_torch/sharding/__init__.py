"""Sharding of the LM substrate over a :class:`~repro_torch.launch.mesh.DeviceMesh`
(the port of ``repro/sharding/``): the logical-axis rules
(``partition.py``) and the block storage a meshed step keeps its state in
(``blocks.py``)."""
