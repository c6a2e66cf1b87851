/** Typed surface of the soundswallower_tpu serving API — the
 * framework's equivalent of the reference's js/index.d.ts (a WASM
 * accelerator binding is a contradiction; the deployment surface of an
 * accelerator-backed decoder is a serving endpoint, see serve.py).
 *
 * Wire schema: the reference's result JSON (README.md:63-74 of the
 * reference; decoder_result_json, src/decoder.c:1502-1593). */

/** One segment node: utterance, word, phone, or HMM state.
 * `b` = begin (seconds), `d` = duration (seconds), `t` = label (hyp
 * text / word / CI phone / senone id), `w` = child segments (words
 * under the utterance, phones under a word, states under a phone —
 * present when the server aligns at that level).  `p` (probability)
 * is present when the server computes per-segment scores; the default
 * throughput configuration omits it (the CLI's fast and --exact paths
 * always emit it). */
export interface Seg {
  b: number;
  d: number;
  p?: number;
  t: string;
  w?: Seg[];
}

/** POST /v1/align request body.  Exactly one of `audio` (base64
 * little-endian int16 PCM at the model's sample rate) or `audio_f32`
 * (base64 little-endian float32 in [-1, 1]) must be present. */
export interface AlignRequest {
  text: string;
  audio?: string;
  audio_f32?: string;
}

export interface HealthResponse {
  status: "ok";
  model: string;
  n_sen: number;
  backend: string;
}

/** GET /v1/config: the effective decoder configuration — the same 74
 * parameter names as the reference's config_defs.h. */
export type ConfigResponse = Record<string, string | number | boolean | null>;

export interface ErrorResponse {
  error: string;
}

/** Dependency-free client for the serving endpoint (js/client.js). */
export class AlignClient {
  constructor(baseUrl?: string);
  baseUrl: string;
  /** Force-align int16 PCM samples against a transcript. */
  align(audio: Int16Array, text: string): Promise<Seg>;
  /** Force-align float32 samples in [-1, 1] against a transcript. */
  alignFloat32(audio: Float32Array, text: string): Promise<Seg>;
  health(): Promise<HealthResponse>;
  config(): Promise<ConfigResponse>;
}
