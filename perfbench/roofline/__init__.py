"""Operations and bytes of one launch of a kernel, from the cell's shapes:
``roofline/<kernel>.py`` names the kernel (``MATCH``, a part of its name
in a device trace) and counts one launch (``counts(model, geometry)``)."""
