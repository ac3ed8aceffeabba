"""Field definitions of the port.

The schema is backend-neutral and shared with the reference: field types,
analyzers and BM25 parameters come from nrtsearch_tpu/schema/fields.py,
which imports neither jax nor torch."""

from nrtsearch_tpu.schema.fields import FieldDef, FieldType, create_field_def

__all__ = ["FieldDef", "FieldType", "create_field_def"]
