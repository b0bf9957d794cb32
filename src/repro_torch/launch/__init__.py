"""Launch helpers of the port: the device meshes of the sharded engine
(``mesh``), the cell programs (``steps``), the LM training launcher
(``train``) and the LM serving launcher (``serve``)."""
