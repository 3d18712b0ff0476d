"""The JAX package's nine examples on the port, each a module with a
``main(argv=None)`` that takes ``--device`` (``cuda`` by default, ``cpu``
for the plain datapath):

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Importing a module runs nothing.  Each keeps the JAX script's sizes,
steps and printed lines; where the round's rules force a difference,
its docstring says which.
"""
