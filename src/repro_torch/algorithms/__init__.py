"""Algorithm engines: edge-centric (HitGraph) and vertex-centric
(AccuGraph) min-combine runs."""
