"""Cloud files. Only the VTK writers that ``VTKFileInspector`` calls are
here so far (:mod:`.vtkio`)."""
