"""Multi-GPU glue of the port: the process group and the rank-local block step."""
