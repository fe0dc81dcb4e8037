"""The model stack of the port: configs, parameters, layers, attention, transformer."""
