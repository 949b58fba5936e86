"""Command-line interface: python -m mp3stego_tpu <op> ...

The reference library has no CLI (README documents the Python API only); this
is an addition exposing the same five façade operations plus the batched
directory-decode throughput mode.
"""

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="mp3stego_tpu",
        description="MP3 codec + steganography on JAX")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print process information")
    p.add_argument("--precision", choices=("float64", "float32"),
                   default="float64",
                   help="decode numeric plane: float64 = bit-exact parity "
                        "(host), float32 = device (<=1 LSB int16 deviation at "
                        "~1e-4 rate)")
    sub = p.add_subparsers(dest="op", required=True)

    d = sub.add_parser("decode", help="MP3 -> WAV")
    d.add_argument("input"), d.add_argument("output")
    d.add_argument("--stream-chunk-frames", type=int, default=0,
                   metavar="N",
                   help="decode in O(chunk) memory windows of N frames "
                        "(bounded-RSS long-file mode; 0 = whole-file)")

    e = sub.add_parser("encode", help="WAV -> MP3")
    e.add_argument("input"), e.add_argument("output")
    e.add_argument("--bitrate", type=int, default=320)
    e.add_argument("--lsf-compliant", action="store_true",
                   help="MPEG-2/2.5 only: write spec-valid ISO 13818-3 side "
                        "info instead of the reference-identical layout "
                        "(which is misaligned and undecodable)")
    e.add_argument("--vbr", action="store_true",
                   help="constant-quality VBR with --bitrate as the target "
                        "average (Xing tag written; beyond the reference)")
    e.add_argument("--stream-chunk-frames", type=int, default=0,
                   help="encode in bounded-memory windows of N frames "
                        "(byte-identical to the whole-file encode; CBR "
                        "only, requires the native host engine)")

    h = sub.add_parser("hide", help="hide a message in an MP3")
    h.add_argument("input"), h.add_argument("output"), h.add_argument("message")
    h.add_argument("--keep-id3", action="store_true",
                   help="carry the input's ID3v2 tag to the output "
                        "(the reference re-encode drops it)")

    r = sub.add_parser("reveal", help="reveal a hidden message")
    r.add_argument("input"), r.add_argument("txt")

    cap = sub.add_parser("capacity",
                         help="max hideable message length for an MP3")
    cap.add_argument("input")

    c = sub.add_parser("clear", help="strip hidden data (re-encode)")
    c.add_argument("input"), c.add_argument("output")
    c.add_argument("--keep-id3", action="store_true",
                   help="carry the input's ID3v2 tag to the output")

    b = sub.add_parser("decode-batch",
                       help="decode many MP3s in one batched device program")
    b.add_argument("inputs", nargs="+")
    b.add_argument("--outdir", default=".")
    b.add_argument("--resume", action="store_true",
                   help="skip inputs whose output WAV already exists")

    be = sub.add_parser("encode-batch", help="encode many WAVs (file-parallel)")
    be.add_argument("inputs", nargs="+")
    be.add_argument("--outdir", default=".")
    be.add_argument("--bitrate", type=int, default=320)
    be.add_argument("--resume", action="store_true",
                    help="skip inputs whose output MP3 already exists")

    args = p.parse_args(argv)
    from mp3stego_tpu import Steganography

    s = Steganography(quiet=not args.verbose, precision=args.precision)
    if args.op == "decode":
        if args.stream_chunk_frames > 0:
            from mp3stego_tpu.models.streaming import decode_file_streaming
            info = decode_file_streaming(
                args.input, args.output,
                chunk_frames=args.stream_chunk_frames)
            print(f"decoded at {info['bitrate']} kbps "
                  f"({info['num_frames']} frames, streaming) "
                  f"-> {args.output}")
        else:
            bitrate = s.decode_mp3_to_wav(args.input, args.output)
            print(f"decoded at {bitrate} kbps -> {args.output}")
    elif args.op == "encode":
        if args.lsf_compliant:
            os.environ["MP3STEGO_TPU_LSF_COMPLIANT"] = "1"
        if args.stream_chunk_frames > 0:
            if args.vbr:
                p.error("--stream-chunk-frames is CBR-only (VBR's rate "
                        "choice needs the whole file)")
            from mp3stego_tpu.models.streaming import encode_file_streaming
            encode_file_streaming(args.input, args.output, args.bitrate,
                                  chunk_frames=args.stream_chunk_frames)
        else:
            s.encode_wav_to_mp3(args.input, args.output, args.bitrate,
                                vbr=args.vbr or None)
        print(f"encoded at {args.bitrate} kbps"
              f"{' average (VBR)' if args.vbr else ''} -> {args.output}")
    elif args.op == "hide":
        if args.keep_id3:
            s.keep_id3 = True
        too_long = s.hide_message(args.input, args.output, args.message)
        print("warning: message truncated (file too short)" if too_long
              else f"hidden -> {args.output}")
        return 1 if too_long else 0
    elif args.op == "capacity":
        print(f"{s.message_capacity(args.input)} chars")
    elif args.op == "reveal":
        s.reveal_massage(args.input, args.txt)
        print(f"revealed -> {args.txt}")
    elif args.op == "clear":
        if args.keep_id3:
            s.keep_id3 = True
        s.clear_file(args.input, args.output)
        print(f"cleared -> {args.output}")
    elif args.op == "decode-batch":
        import os

        from mp3stego_tpu.bitstream import decoder_host as dh
        from mp3stego_tpu.bitstream.id3 import parse_id3
        from mp3stego_tpu.parallel import decode_files_batched
        from mp3stego_tpu.utils.wav import write_wav

        def out_of(path):
            return os.path.join(
                args.outdir,
                os.path.splitext(os.path.basename(path))[0] + ".wav")

        inputs = [p for p in args.inputs
                  if not (args.resume and os.path.exists(out_of(p)))]
        skipped = len(args.inputs) - len(inputs)
        if skipped:
            print(f"resume: skipping {skipped} already-decoded file(s)")
        pcms = decode_files_batched(inputs, errors="isolate",
                                    out="int16") if inputs else []
        rc = 0
        for path, pcm in zip(inputs, pcms):
            if isinstance(pcm, Exception):
                print(f"{path}: FAILED ({pcm})")
                rc = 1
                continue
            with open(path, "rb") as f:
                data = f.read()
            id3 = parse_id3(data)
            off = id3.offset if id3.is_valid else 0
            rate = dh.parse_header(*data[off:off + 4]).sampling_rate or 44100
            out = out_of(path)
            write_wav(out, rate, pcm)   # already int16 (device-fused)
            print(f"{path} -> {out}")
        return rc
    elif args.op == "encode-batch":
        import os

        from mp3stego_tpu.parallel import encode_files_batched

        def out_of(path):
            return os.path.join(
                args.outdir,
                os.path.splitext(os.path.basename(path))[0] + ".mp3")

        jobs = [(p, out_of(p)) for p in args.inputs
                if not (args.resume and os.path.exists(out_of(p)))]
        skipped = len(args.inputs) - len(jobs)
        if skipped:
            print(f"resume: skipping {skipped} already-encoded file(s)")
        outs = encode_files_batched(jobs, bitrate=args.bitrate,
                                    errors="isolate")
        rc = 0
        for (src, _), res in zip(jobs, outs):
            if isinstance(res, Exception):
                print(f"{src}: FAILED ({res})")
                rc = 1
            else:
                print(f"{src} -> {res}")
        return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
