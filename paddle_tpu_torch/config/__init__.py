"""Model graph configuration: the ModelDef dataclasses and the DSL."""
