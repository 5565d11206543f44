"""Multi-device aggregation on torch.distributed: the runtime and meshes
(multihost.py), the clients x chunks round (mesh.py) and a one-host rank
launcher (launch.py)."""
