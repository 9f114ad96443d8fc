"""Host runtime pieces the port needs: chaos specs and the journal."""
