"""CLI for poke data collection with online material classification
(reference collectdataPoke.py:409-434).

Port of ``mrgan_tpu/cli/collect.py``: collect poke data for one object
against the C++ firmware simulators and the simulated PR2, producing raw
pickles with the real schema, and with ``--classifier`` classify each poke
on ``--device`` (the card unless ``--device cpu``) as it is collected:

    python -m mrgan_tpu_torch.cli.collect -n metal_block -s 6 \\
        --material metal --classifier clf.pkl --no-camera

The checkpoint is a ``serve.MaterialClassifier`` snapshot: the port's, or
the JAX package's (the same pickled-numpy schema).
"""

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Collecting data from a spinning platter of objects.")
    parser.add_argument("-n", "--name", required=True, help="Object name")
    parser.add_argument("-s", "--seqs", type=int, required=True,
                        help="Data collection sequences (pokes) per objects")
    parser.add_argument("-f", "--flat", action="store_true")
    parser.add_argument("-qf", "--quarterflat", action="store_true")
    parser.add_argument("-v", "--vertmove", action="store_true")
    parser.add_argument("-ro", "--rotateonce", action="store_true")
    parser.add_argument("-nr", "--neverrotate", action="store_true")
    parser.add_argument("-cs", "--curvedsurface", action="store_true")
    parser.add_argument("-w", "--width", type=float, default=0.0)
    parser.add_argument("-l", "--length", type=float, default=0.0)
    parser.add_argument("-ht", "--height", type=float, default=0.0)
    parser.add_argument("-hto", "--heightoffset", type=float, default=0.0)
    parser.add_argument("-iw", "--initwidth", type=float, default=0.0)
    parser.add_argument("-sc", "--startcount", type=int, default=0)
    parser.add_argument("-sim", "--simulation", action="store_true")
    parser.add_argument("-hndl", "--handle", action="store_true")
    # sim-stack extensions
    parser.add_argument("--material", default="plastic",
                        help="Simulated object material")
    parser.add_argument("--timescale", type=float, default=20.0,
                        help="Simulation speed multiplier")
    parser.add_argument("--data-dir", default="data_raw")
    parser.add_argument("--classifier", default=None, metavar="CKPT",
                        help="serve.MaterialClassifier checkpoint: classify "
                        "each poke online and publish the prediction on "
                        "/semihaptics/prediction")
    parser.add_argument("--gains", default="active",
                        help="Arm gain profile: grasp | original | active "
                        "(the change_gains_pr2.sh symlink) | path (C17)")
    parser.add_argument("--no-camera", action="store_true",
                        help="Do not start the sim Kinect; objectImage is "
                        "saved as None like a camera-less session")
    parser.add_argument("--per-poke-images", action="store_true",
                        help="Also grab an image per poke into 'images' "
                        "(the reference's commented-out grab, :366)")
    parser.add_argument("--device", default="cuda",
                        help="Where the classifier runs: cuda (default) or "
                        "cpu")
    args = parser.parse_args(argv)

    from ..acquisition import collect, controller, publishers, serialdev
    from ..acquisition.bus import BusServer, SimClock
    from ..utils.device import resolve

    device = resolve(args.device)
    classifier = None
    if args.classifier:
        from ..serve import MaterialClassifier

        classifier = MaterialClassifier.load(args.classifier, device=device)

    clock = SimClock(args.timescale)
    server = BusServer()
    thermal = mic = temp_pub = mic_pub = camera = world = None
    try:
        thermal = serialdev.setup_serial(
            serialdev.thermal_sim_argv(timescale=args.timescale))
        # keep the wall line rate within what the reader sustains
        # (~25k lines/s)
        mic_rate = min(4000.0, 25000.0 / args.timescale)
        mic = serialdev.setup_serial(
            serialdev.contactmic_sim_argv(timescale=args.timescale,
                                          rate=mic_rate))

        temp_pub = publishers.TemperaturePublisher(server.address, clock,
                                                   thermal)
        mic_pub = publishers.ContactMicPublisher(server.address, clock, mic)
        temp_pub.start()
        mic_pub.start()
        if not args.no_camera:
            camera = publishers.CameraPublisher(server.address, clock,
                                                object_name=args.name,
                                                material=args.material)
            camera.start()

        world = controller.SimWorld(server.address, clock, thermal, mic,
                                    material=args.material,
                                    axis=2 if args.vertmove else 1)
        world.start()
        control = controller.SimController(vertical_movement=args.vertmove,
                                           world=world, clock=clock,
                                           gain_profile=args.gains)

        collector = collect.CollectData(
            args.name, server.address, clock, control,
            sequences_per_object=args.seqs, start_count=args.startcount,
            vertical_movement=args.vertmove, data_dir=args.data_dir,
            verbose=True, flat=args.flat, quarterflat=args.quarterflat,
            rotateonce=args.rotateonce, handle=args.handle,
            neverrotate=args.neverrotate, classifier=classifier,
            capture_images=not args.no_camera,
            per_poke_images=args.per_poke_images,
            width=args.width, length=args.length, height=args.height,
            height_offset=args.heightoffset, init_width=args.initwidth,
            curvedsurface=args.curvedsurface)
        saved = collector.performInteraction(rng=np.random)
        print("Saved:", saved)
        return collector
    finally:
        if world is not None:
            world.stop()
        for node in (temp_pub, mic_pub, camera):
            if node is not None:
                node.close()
        for dev in (thermal, mic):  # closed by their publishers if started
            if dev is not None and dev.proc.poll() is None:
                dev.close()
        server.close()


if __name__ == "__main__":
    main()
