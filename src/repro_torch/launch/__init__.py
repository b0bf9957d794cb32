"""Launch helpers of the port: the device meshes of the sharded engine
(``mesh``)."""
