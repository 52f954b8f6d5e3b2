"""Boundary-condition and body ids (twin of pelvistim_fem_tpu/mesh/core.py
constants; the TetMesh data model is not part of this package yet)."""

# Boundary-condition ids: 1 = active electrode, 2 = return electrode,
# 3 = insulated.
BC_ACTIVE = 1
BC_RETURN = 2
BC_INSULATED = 3

# Body (material) ids of the layered models.
BODY_MUSCLE = 1
BODY_FAT = 2
BODY_SKIN = 3
BODY_CONTACT_ACTIVE = 4
BODY_CONTACT_RETURN = 5
# single-tissue box models
BODY_TISSUE = 1
