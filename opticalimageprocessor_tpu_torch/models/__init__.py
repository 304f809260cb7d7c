"""The port's pipelines: the scene pipeline (``device_pipeline.ScenePipeline``,
``scene.run_scene``), the file commands' routes (``preprocessor.PreProcessor``,
``stitcher.Stitcher`` and ``stitch``; over the line mesh
``sharded_align.run_sharded_align`` and
``sharded_prestitch.run_sharded_prestitch``) and the host-only downlink
separation (``auxsep.AuxSeparator``)."""
