"""Serving of the port: page allocator, decode engine, model store, server.

Importing this package loads no engine or server: each submodule is
imported where it is used, so ``kvpool`` stays numpy-only.
"""
