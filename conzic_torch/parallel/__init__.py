"""Scale-out: data meshes of devices in one process (``mesh``) and several
processes (``distributed``)."""
