"""Scale-out of the port: the operator's env contract and process-group
start-up (``distributed.py``), and the device mesh with its sharding
rules (``mesh.py``). The collectives are ``ops/collectives.py``."""
