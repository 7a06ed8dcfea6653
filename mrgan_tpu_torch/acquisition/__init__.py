"""Data-acquisition stack (reference datacollection/, SURVEY.md C12-C17).

Port of ``mrgan_tpu/acquisition/``: the same modules, names and raw pickle
schema, with nothing of JAX (numpy, threads and sockets over the C++
firmware simulators of ``native/``). The reference runs on a PR2 with ROS
pub/sub, two Teensy boards on serial, and actionlib arm controllers.
Rebuilt here as:

- ``bus``         lightweight TCP JSON-line pub/sub replacing the ROS topic
                  graph (/semihaptics/{temperature,contactmic,datastate,
                  collisiontime} + PR2 sensor topics);
- ``serialdev``   pipe-backed serial device talking to the C++ firmware
                  simulators (thermal_sim, contactmic_sim), built from
                  ``native/`` into ``build/mrgan_tpu_torch/bin/``;
- ``publishers``  the temperature / contact-mic publisher state machines
                  (zeroing/start/record/stop, 'H' hold on contact, bulk
                  replay) mirroring datacollection/publishers/*.py;
- ``controller``  simulated PR2 arm + fingertip sensor streams + the contact
                  physics that couples pokes into both firmware sims;
- ``collect``     the CollectData orchestrator (poke state machine, batch
                  saves, --startcount resume) mirroring collectdataPoke.py,
                  with the per-poke classifier hook of the serving path
                  (``serve.MaterialClassifier.classify_raw_poke``).

Everything runs against a scalable sim clock so a full multi-poke collection
executes in seconds and produces raw pickles that flow through
``data/preprocess.py`` -> the loaders -> the tables unchanged.
"""
