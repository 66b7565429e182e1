"""Band-tiled single-image encode: MCU-row bands, DC predictors chained.

Port of jpeg_encoder_tpu/parallel/tiled.py. The JAX package splits one
image into contiguous MCU-row bands, one per device of a mesh, and passes
each band's final DC predictors to its successor with one ppermute. Here
`bands` is the band count and `devices` (a count of cards or a list of
devices, parallel/devices.py) takes the mesh's place: the bands go in
contiguous runs (BandRun), one a device, and the bands of a run are the
leading dimension of one launch of each kernel on its device:

* the band front: the run's image rows, zero-padded to count * band_h
  rows, go through pipeline.scan_entries as a (count, band_h, W, 3)
  stack, as the batch path stacks images, with the rows at or past the
  image height zeroed in the Y, Cb and Cr planes (the reference's padding
  is 0 there, not in RGB, where zero pixels convert to Cb = Cr = 128). The
  stack's entries, band after band, are those of one image of count *
  band_h rows (the stack geometry);
* the unbroken scan: K4 codes a run's stack in one launch as rows of one
  band's entries, row r seeded with the final DCs of the band before
  (ops/entropy.final_dc_of_entries over the stack's entries, on the
  device; zeros for the image's first band). The last band of a run hands its final DCs to the
  next run's device: the ppermute's one hop, a (1, 3) copy on the sending
  run's stream, awaited by the receiving run's stream (devices.send). The
  run's live entry count makes the padding bands' entries emit nothing
  (dead entries are always a suffix, and a run of dead bands does no work
  at all). The host splices the rows at bit level (utils/bits.py);
* restart markers: every non-final band holds whole intervals (the band
  size is re-chosen when the even split puts an interval across a band
  boundary, _aligned_band_rows), so K4 codes every interval of a run into
  its own row with its predictors reset, and the host joins the bands'
  live intervals with RSTn markers: no DC exchange, no splice;
* optimize: one table set from the statistics of all bands: each run's
  symbol_histograms with the encode's per-row predictors, summed on the
  first device (the JAX package's psum), the tables built on the host and
  copied to every device, then the encode above with them;
* overflow: a band whose payload (or any of its intervals) overflowed the
  shared per-band capacity is re-coded alone on its run's device from its
  live entries (the front does not run again) up the capacity ladder, with
  its own predictors; the other bands keep their rows.

parallel/multihost.encode_tiled runs the same runs across processes.
Files are byte-identical to pipeline.encode_array's. As there, the quirk
geometries (dim % (8 * factor) == 1) and a restart interval that admits no
band split fall back to encode_array with a RuntimeWarning. Like the JAX
package's band path (and the batch path), this one does not check
config.validate. Without `devices` every band runs on one device (one run),
where the bands buy nothing but the splice.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from jpeg_encoder_torch import graphs, pipeline
from jpeg_encoder_torch.config import EncoderConfig, FrameGeometry
from jpeg_encoder_torch.io import jfif
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.parallel import devices as devices_lib
from jpeg_encoder_torch.utils.bits import splice_bitstreams


def tileable(geom: FrameGeometry) -> bool:
    """Band-local encoding requires aligned luma/chroma grids.

    dim % (8*factor) == 1 images hit the reference's global chroma/luma
    grid misalignment (oracle.subsample_plane), which band-local encoding
    cannot reproduce: encode_tiled falls back to encode_array for them.
    """
    return geom.mcu_grid_aligned


def _band_rows(geom: FrameGeometry, bands: int) -> int:
    """MCU rows per band: ceil so `bands` equal bands cover the image."""
    return -(-geom.mcu_rows // bands)


def _aligned_band_rows(
    geom: FrameGeometry, bands: int, restart: int
) -> int | None:
    """Smallest restart-aligned band size that still splits the image.

    Every NON-final band must hold a whole number of intervals (an
    interval must not straddle a band boundary); the final band may end
    mid-interval. The search runs upward from the even split and stops at
    twice it (past that most bands are dead padding and one encode is the
    cheaper program). None when no aligned split exists within the bound
    (or only the degenerate single-live-band one does).
    """
    base = _band_rows(geom, bands)
    for rows in range(base, min(2 * base + 1, geom.mcu_rows)):
        if (rows * geom.mcu_cols) % restart == 0:
            return rows
    return None


def _live_mcu_rows(geom: FrameGeometry, band_rows: int, idx: int) -> int:
    """MCU rows of band idx that lie in the image."""
    return max(0, min(geom.mcu_rows - idx * band_rows, band_rows))


def _band_geometry(geom: FrameGeometry, band_h: int) -> FrameGeometry:
    """Geometry of one full-width band of band_h pixel rows (a multiple of
    the MCU height)."""
    band = FrameGeometry(
        width=geom.width,
        height=band_h,
        h_factor=geom.h_factor,
        v_factor=geom.v_factor,
    )
    assert band.padded_height == band_h
    return band


def _band_entries(geom: FrameGeometry, band_rows: int) -> int:
    """Scan entries of a band of band_rows MCU rows."""
    return band_rows * geom.mcu_cols * geom.blocks_per_mcu


def _split_rows(geom: FrameGeometry, bands: int,
                restart: int | None) -> int | None:
    """MCU rows per band for this encode; None when a restart interval
    admits no band split (the caller falls back to one encode)."""
    band_rows = _band_rows(geom, bands)
    live_bands = -(-geom.mcu_rows // band_rows)
    if restart is None or live_bands == 1 or (
        (band_rows * geom.mcu_cols) % restart == 0
    ):
        return band_rows
    # The even split puts an interval across a band boundary; the band
    # size is ours to choose.
    aligned = _aligned_band_rows(geom, bands, restart)
    if aligned is not None and -(-geom.mcu_rows // aligned) > 1:
        return aligned
    return None


def prepare(rgb: np.ndarray, config: EncoderConfig, bands: int):
    """Check a band encode's operands -> (the image's geometry, MCU rows a
    band), or (geometry, None) when it falls back to one encode (the
    quirk geometries, and a restart interval that admits no band split),
    having said so with a RuntimeWarning."""
    pipeline.check_config(config)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("expected (H, W, 3) RGB input")
    if bands < 1:
        raise ValueError(f"bands must be at least 1, got {bands}")
    height, width = rgb.shape[:2]
    geom = config.geometry(width, height)
    restart = config.restart_interval
    if restart is not None:
        # The clear restart-vs-quirk-geometry error, before any warning.
        pipeline.check_restart_geometry(geom)
    if not tileable(geom):
        # The reference accepts these inputs (main.rs:8-68): encode them
        # in one piece, byte-identically, and say so.
        warnings.warn(
            f"dimensions {geom.width}x{geom.height} hit the reference's "
            "dim % (8*factor) == 1 chroma-grid misalignment quirk, which "
            "band-local encoding cannot reproduce; falling back to a "
            "single-band encode",
            RuntimeWarning,
            stacklevel=3,
        )
        return geom, None
    band_rows = _split_rows(geom, bands, restart)
    if band_rows is None:
        warnings.warn(
            f"restart interval {restart} admits no band split of the "
            f"{geom.mcu_rows}x{geom.mcu_cols}-MCU grid into {bands} bands "
            "(every candidate band would put an interval across a band "
            "boundary); falling back to a single-band restart encode",
            RuntimeWarning,
            stacklevel=3,
        )
    return geom, band_rows


def encode_tiled(
    rgb: np.ndarray,
    config: EncoderConfig,
    bands: int,
    *,
    device: str | torch.device = "cuda",
    devices=None,
) -> pipeline.EncodeResult:
    """Encode one (H, W, 3) uint8 image as `bands` MCU-row bands on
    `device` (the card by default; "cpu" runs the plain versions), or
    over `devices` (a count of cards or a list of devices, which may
    repeat one): the bands then go in contiguous runs, one a device, and
    the last band of each run hands its final DCs to the next run's first.

    With config.restart_interval the bands emit DRI/RSTn restart framing:
    every interval's predictors reset, so no DC chain crosses a band, and
    assembly is marker concatenation. When the even split misaligns with
    the interval the band size is re-chosen (_aligned_band_rows); only a
    geometry with no aligned multi-band split falls back to encode_array
    on the first device, with a warning.
    """
    shares = devices_lib.shares(device, devices)
    geom, band_rows = prepare(rgb, config, bands)
    if band_rows is None:
        return pipeline.encode_array(rgb, config, device=shares[0].device)
    restart = config.restart_interval
    runs = [(share, run) for share, run in zip(
        shares, BandRun.split(geom, band_rows, bands, len(shares)))
        if run.live_entries]
    fronts = []
    for share, run in runs:
        with share.on():
            fronts.append(run.front(rgb, config, share.device))
    inits = [None] * len(runs)
    if restart is None:
        # The ppermute's one hop: run i's last final DCs to run i + 1.
        for i, (share, _) in enumerate(runs):
            incoming = None if i == 0 else devices_lib.send(
                fronts[i - 1][1][-1:], runs[i - 1][0], share)
            with share.on():
                inits[i] = chained(fronts[i][1], incoming)
    specs = None
    luts = [None] * len(runs)
    if config.optimize_huffman:
        # One table set from every band's statistics (the psum), summed on
        # the first share, built on the host and copied to every share.
        hists = []
        for (share, run), (z, _), init in zip(runs, fronts, inits):
            with share.on():
                hists.append(run.histogram(z, init, restart))
        first = runs[0][0]
        total = hists[0]
        for (share, _), hist in zip(runs[1:], hists[1:]):
            hist = devices_lib.send(hist, share, first)
            with first.on():
                total = total + hist
        with first.on():
            specs, host_luts = pipeline.optimal_specs_and_luts(
                total.cpu().numpy(), "cpu")
        for i, (share, _) in enumerate(runs):
            with share.on():
                luts[i] = tuple(t.to(share.device) for t in host_luts)
    enqueued = []
    for (share, run), (z, _), init, tables in zip(runs, fronts, inits, luts):
        with share.on():
            enqueued.append(run.encode(z, init, tables, config))
    pieces = []
    for (share, run), (z, _), init, tables, out in zip(
            runs, fronts, inits, luts, enqueued):
        with share.on():
            pieces.extend(run.collect(z, *batch.fetch_chunk(*out), init,
                                      tables, config))
    return assemble(geom, config, pieces, specs)


def assemble(geom, config, pieces, specs) -> pipeline.EncodeResult:
    """The file from every band's (payload, bits) in order: the unbroken
    scan's bands spliced at bit level, or the restart intervals joined
    with RSTn markers."""
    restart = config.restart_interval
    if restart is not None:
        return pipeline.restart_result(
            geom, [p for p, _ in pieces], [b for _, b in pieces], restart,
            config.quality, dht_specs=specs)
    spliced, total_bits = splice_bitstreams(pieces)
    return pipeline.EncodeResult(
        file_bytes=jfif.assemble(geom, spliced, quality=config.quality,
                                 dht_specs=specs),
        entropy_payload=spliced,
        bit_length=total_bits,
        geom=geom,
    )


@dataclasses.dataclass(frozen=True)
class BandRun:
    """Bands first .. first + count - 1 of an image of geometry `geom`
    split into bands of band_rows MCU rows: the work of one device (or
    process), on the device its caller makes current."""

    geom: FrameGeometry
    band_rows: int
    first: int
    count: int

    @classmethod
    def split(cls, geom, band_rows, bands, parts) -> list[BandRun]:
        """`bands` bands in contiguous runs over at most `parts` devices
        (devices.split)."""
        return [cls(geom, band_rows, lo, hi - lo)
                for lo, hi in devices_lib.split(bands, parts)]

    @property
    def band_geom(self) -> FrameGeometry:
        return _band_geometry(self.geom, self.band_rows * 8 *
                              self.geom.v_factor)

    @property
    def stack_geom(self) -> FrameGeometry:
        """The geometry of the run's bands stacked: one image of count
        bands' rows."""
        return _band_geometry(self.geom, self.count * self.band_geom.height)

    @property
    def band_entries(self) -> int:
        return _band_entries(self.geom, self.band_rows)

    @property
    def live_entries(self) -> int:
        """Entries of the run in the image (0 for a run of dead bands,
        which are a suffix of the bands)."""
        return max(0, min(self.geom.num_scan_entries
                          - self.first * self.band_entries,
                          self.count * self.band_entries))

    def front(self, rgb, config, device):
        """band_front over this run on `device`."""
        return band_front(rgb, config, self.geom, self.band_rows,
                          self.first, self.count, device)

    def histogram(self, z, init_dc, restart):
        """(4, 256) symbol counts of the run's entries, its rows (bands,
        or restart intervals) framed and seeded as the encode's: one
        program (graphs.run), the JAX package's compiled_tiled_stats."""
        framing = restart or self.band_rows * self.geom.mcu_cols

        def program(z, init_dc=None):
            return entropy_ops.symbol_histograms(
                z, self.stack_geom, framing, init_dc,
                live_entries=self.live_entries)

        key = ("band_stats", self.stack_geom, self.band_rows, self.first,
               restart, self.live_entries)
        return graphs.run(key, program, _operands(z, init_dc), z.device)

    def capacity(self, config) -> int:
        """The shared capacity of a band (of an interval with restart
        markers)."""
        if config.restart_interval is None:
            return pipeline.default_capacity_bytes(
                self.band_geom, config.capacity_bytes_per_pixel)
        return pipeline.restart_default_capacity_bytes(
            self.band_geom, config.restart_interval,
            config.capacity_bytes_per_pixel)

    def encode(self, z, init_dc, luts, config):
        """Enqueue one K4 launch over the run: a row a band seeded from
        its init_dc row, or, with restart markers, a row an interval with
        its predictors reset. -> (payloads, bits) on z's device. One
        program (graphs.run), the JAX package's compiled_band_encoder and
        compiled_band_restart_encoder; init_dc and luts are copied into
        its buffers."""
        restart = config.restart_interval
        epi = (self.band_entries if restart is None
               else entropy_ops.entries_per_interval(self.stack_geom, restart))
        capacity = self.capacity(config)

        def program(z, init_dc=None, dc_lut=None, ac_lut=None):
            return entropy_kernel.encode_entries(
                z, self.stack_geom, capacity, init_dc,
                None if dc_lut is None else (dc_lut, ac_lut),
                live_entries=self.live_entries, entries_per_interval=epi)

        key = ("band_encode", self.stack_geom, self.band_rows, self.first,
               restart, self.live_entries, capacity, luts is not None)
        return graphs.run(key, program, _operands(z, init_dc, luts),
                          z.device)

    def collect(self, z, payloads, bit_lengths, init_dc, luts, config):
        """The run's fetched rows -> [(payload, bits)] in scan order: one a
        band (dead ones emit 0 bits), or one a live restart interval. A
        band whose payload (or any interval's) overflowed the shared
        capacity is re-coded alone on z's device."""
        geom, band_rows, restart = self.geom, self.band_rows, (
            config.restart_interval)
        capacity = self.capacity(config)
        pieces = []
        if restart is None:
            for j in range(self.count):
                bits = int(bit_lengths[j])
                if bits <= 8 * capacity:
                    pieces.append((payloads[j], bits))
                else:
                    # This band overflowed the shared estimate: re-code it.
                    pieces.append(_retry_band(
                        z, geom, band_rows, self.first + j, capacity,
                        init_dc[j], luts, self.first))
            return pieces
        # Non-final bands hold whole intervals, so band j's intervals are
        # rows j * band_mcus / restart on; a single live band starts at 0.
        per_band = band_rows * geom.mcu_cols // restart
        for j in range(self.count):
            idx = self.first + j
            n_live = -(-_live_mcu_rows(geom, band_rows, idx) * geom.mcu_cols
                       // restart)
            rows = range(j * per_band, j * per_band + n_live)
            if n_live and int(bit_lengths[rows.start:rows.stop].max()) > (
                    8 * capacity):
                pieces.extend(_retry_band_restart(
                    z, geom, band_rows, idx, capacity, restart, luts,
                    self.first))
            else:
                pieces.extend((payloads[r], int(bit_lengths[r]))
                              for r in rows)
        return pieces


def band_front(
    rgb: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    band_rows: int,
    first: int,
    count: int,
    device: str | torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The band front of bands first .. first + count - 1 on `device`: the
    image rows they cover, zero-padded to count bands of band_rows MCU
    rows, through pipeline.scan_entries as a (count, band_h, W, 3) stack,
    its rows at or past the image height zeroed in the Y, Cb and Cr
    planes. -> (the stack's (count * E_band, 64) scan entries, band after
    band; (count, 3) int32 final DC predictors of each band,
    ops/entropy.final_dc_of_entries). Only those image rows go up, through
    pipeline.upload (on a card the calling thread's pinned ring)."""
    band_geom = _band_geometry(geom, band_rows * 8 * geom.v_factor)
    top = first * band_geom.height
    rows = max(0, min(rgb.shape[0] - top, count * band_geom.height))
    device = torch.device(device)
    live = pipeline.upload(rgb[top : top + rows], device)
    return stack_front(live, config, band_geom, first, count, device)


def stack_front(
    live: torch.Tensor,
    config: EncoderConfig,
    band_geom: FrameGeometry,
    first: int,
    count: int,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """band_front's device part, one program (graphs.run; the JAX package's
    compiled_tiled_encoder front): the (rows, W, 3) image rows of bands
    first .. first + count - 1 (on the host or on device) go into the top
    of the program's zeroed (count * band_h, W, 3) stack, through
    pipeline.scan_entries with the rows at or past `rows` outside the
    image -> (the stack's scan entries, (count, 3) final DCs of each band).
    Enqueued on the current stream; nothing read back. The band programs
    are keyed by their run's first band: one encode holds every run's
    outputs at once, and runs may share a stream."""
    rows, width = live.shape[:2]
    band_h = band_geom.height

    def program(rgb):
        z, _ = pipeline.scan_entries(
            rgb.reshape(count, band_h, width, 3), band_geom,
            config.dct_algorithm, config.quality, fast_dct=config.fast_dct,
            bin_dct_descale=config.bin_dct_descale, live_rows=rows,
        )
        return z, entropy_ops.final_dc_of_entries(z, band_geom)

    key = ("band_front", band_geom, first, count, rows,
           *pipeline.dct_key(config))
    return graphs.run(key, program, {"rgb": live}, device,
                      pad={"rgb": count * band_h})


def _operands(z, init_dc=None, luts=None) -> dict:
    """A band program's inputs: z, and init_dc and the (dc, ac) tables
    where given."""
    inputs = {"z": z}
    if init_dc is not None:
        inputs["init_dc"] = init_dc
    if luts is not None:
        inputs["dc_lut"], inputs["ac_lut"] = luts
    return inputs


def chained(lasts: torch.Tensor, incoming: torch.Tensor | None = None):
    """(count, 3) final DCs of a run's bands -> their (count, 3) initial
    predictors: `incoming` (the final DCs of the band before the run;
    zeros for the image's first band) for the first, then each band's
    predecessor's."""
    if incoming is None:
        incoming = torch.zeros_like(lasts[:1])
    return torch.cat([incoming.reshape(1, 3), lasts[:-1]])


def _live_band(z, geom, band_rows, idx, first=0):
    """Band idx's live entries (a view of z, the entries of the run that
    starts at band `first`) and their geometry: the live prefix of a
    band's entries is the scan of its live MCU rows."""
    live_rows = _live_mcu_rows(geom, band_rows, idx)
    live_geom = _band_geometry(geom, live_rows * 8 * geom.v_factor)
    start = (idx - first) * _band_entries(geom, band_rows)
    return z[start : start + live_geom.num_scan_entries], live_geom


def _retry_band(
    z: torch.Tensor,
    geom: FrameGeometry,
    band_rows: int,
    idx: int,
    capacity: int,
    init_dc: torch.Tensor,
    luts: tuple | None = None,
    first: int = 0,
) -> tuple[np.ndarray, int]:
    """Re-code band idx's live entries alone (z: the entries of the run
    that starts at band `first`), from its own (3,) init_dc, up the
    capacity ladder from the rung above the one that overflowed."""
    z_band, live_geom = _live_band(z, geom, band_rows, idx, first)

    def encode(cap):
        payload, bits = entropy_kernel.encode_entries(
            z_band, live_geom, cap, init_dc, luts
        )
        return {"payload": payload, "total_bits": bits}

    out = pipeline._climb_capacity_ladder(
        encode, live_geom, pipeline.next_capacity_bytes(live_geom, capacity),
        None, False,
    )
    bits = int(out["total_bits"])
    return out["payload"][: (bits + 7) // 8].cpu().numpy(), bits


def _retry_band_restart(
    z: torch.Tensor,
    geom: FrameGeometry,
    band_rows: int,
    idx: int,
    capacity: int,
    restart: int,
    luts: tuple | None = None,
    first: int = 0,
) -> list[tuple[np.ndarray, int]]:
    """Re-code band idx's restart intervals alone (z: the entries of the
    run that starts at band `first`), up the capacity ladder from the rung
    above the one that overflowed."""
    z_band, live_geom = _live_band(z, geom, band_rows, idx, first)
    epi = entropy_ops.entries_per_interval(live_geom, restart)

    def encode(cap):
        payloads, bits = entropy_kernel.encode_entries(
            z_band, live_geom, cap, luts=luts, entries_per_interval=epi
        )
        return {"payloads": payloads, "bits": bits}

    out = pipeline._climb_capacity_ladder(
        encode, live_geom,
        pipeline.restart_next_capacity_bytes(live_geom, restart, capacity),
        restart, False,
    )
    payloads, bits = batch.fetch_chunk(out["payloads"], out["bits"])
    return [(p, int(b)) for p, b in zip(payloads, bits)]
