"""Field definitions of the port (counterpart: nrtsearch_tpu/schema/).

``fields.py`` is the port's own copy of the reference's backend-free field
types, analyzers and BM25 parameters."""

from nrtsearch_tpu_torch.schema.fields import FieldDef, FieldType, create_field_def

__all__ = ["FieldDef", "FieldType", "create_field_def"]
