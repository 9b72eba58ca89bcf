"""Scale-out of the port. So far only the operator's env contract
(``distributed.py``); meshes and collectives are ROADMAP Queue A 7."""
