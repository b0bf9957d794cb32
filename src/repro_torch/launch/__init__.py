"""Launch helpers of the port: the device meshes of the sharded engine
(``mesh``) and the LM serving launcher (``serve``)."""
