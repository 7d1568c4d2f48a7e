"""The dense GQA decoder: parameter defs, layers, attention, assembly."""
